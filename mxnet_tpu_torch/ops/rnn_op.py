"""The fused multi-layer ``RNN`` op (LSTM / GRU / vanilla, optionally
bidirectional) and ``_rnn_begin_state`` — the port of
``mxnet_tpu/ops/rnn_op.py``.

The JAX package runs the recurrence as ``lax.scan``, which XLA
compiles; there is no Pallas kernel behind it, so the port runs torch's
own recurrent functions (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``) one layer at a time: cuDNN on the card, ATen's native
loop on the CPU, the same call on both.  Both compute the input
projection of all T steps as one product before the recurrence, as the
reference hoists it out of its scan.  The reference's gate orders (LSTM
i, f, g, o; GRU r, z, n with r applied to ``W_hn h + b_hn``) and its
separate i2h / h2h biases are torch's, so every weight handed to torch
is a view of the flat parameter blob and autograd returns the blob's
gradient.  Between layers, ``p`` drops with a mask drawn from the
executor's generator, in training only (torch's own inter-layer dropout
would draw from the global generator).

Flat parameter layout (``_layout``, FusedRNNCell's pack / unpack)::

    for layer: for direction:  W[gates*H, in_size] (i2h), R[gates*H, H] (h2h)
    then for layer: for direction:  bW[gates*H] (i2h), bR[gates*H] (h2h)

with in_size = the input width at layer 0, else H * directions.

Inputs: data (T, N, I), parameters (flat,), state (L*D, N, H)
[, state_cell]; outputs: out (T, N, H*D) [, state_out [, statecell_out]],
only ``out`` visible unless ``state_outputs``.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, state_size, mode, bidirectional, input_size):
    """Total flat parameter count."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_size + state_size)  # W + R
    size += num_layers * d * 2 * g * state_size              # biases
    return size


def _layout(num_layers, state_size, mode, bidirectional, input_size):
    """(name, offset, shape) of every packed tensor, in pack order."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    off = 0
    out = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * d
        for dr in range(d):
            out.append(("l%d_d%d_i2h_weight" % (layer, dr), off,
                        (g * state_size, in_size)))
            off += g * state_size * in_size
            out.append(("l%d_d%d_h2h_weight" % (layer, dr), off,
                        (g * state_size, state_size)))
            off += g * state_size * state_size
    for layer in range(num_layers):
        for dr in range(d):
            out.append(("l%d_d%d_i2h_bias" % (layer, dr), off,
                        (g * state_size,)))
            off += g * state_size
            out.append(("l%d_d%d_h2h_bias" % (layer, dr), off,
                        (g * state_size,)))
            off += g * state_size
    return out


def _num_inputs(attrs):
    return 4 if attrs["mode"] == "lstm" else 3


def _arguments(attrs):
    if attrs["mode"] == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _num_outputs(attrs):
    return 3 if attrs["mode"] == "lstm" else 2


def _num_visible(attrs):
    return _num_outputs(attrs) if attrs.get("state_outputs", False) else 1


def _outputs(attrs):
    if attrs["mode"] == "lstm":
        return ["output", "state", "state_cell"]
    return ["output", "state"]


def _infer_shape(attrs, in_shapes, aux_shapes):
    T, N, I = in_shapes[0]
    H = attrs["state_size"]
    L = attrs["num_layers"]
    D = 2 if attrs.get("bidirectional", False) else 1
    psize = rnn_param_size(L, H, attrs["mode"], D == 2, I)
    state_shape = (L * D, N, H)
    ins = [in_shapes[0], (psize,), state_shape]
    outs = [(T, N, H * D), state_shape]
    if attrs["mode"] == "lstm":
        ins.append(state_shape)
        outs.append(state_shape)
    return ins, outs, []


def _rnn(attrs, inputs, aux, octx):
    data, params, state = inputs[0], inputs[1], inputs[2]
    mode = attrs["mode"]
    H = attrs["state_size"]
    L = attrs["num_layers"]
    bidir = attrs.get("bidirectional", False)
    D = 2 if bidir else 1
    p_drop = attrs.get("p", 0.0)
    state_cell = inputs[3] if mode == "lstm" else None
    views = {name: params[off:off + math.prod(shape)].view(shape)
             for name, off, shape in _layout(L, H, mode, bidir,
                                             data.shape[2])}
    fn = getattr(torch._VF, mode)   # lstm, gru, rnn_tanh, rnn_relu
    x = data
    hs, cs = [], []
    for layer in range(L):
        weights = []
        for dr in range(D):
            weights += [views["l%d_d%d_%s" % (layer, dr, part)]
                        for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                                     "h2h_bias")]
        h0 = state[layer * D:(layer + 1) * D]
        with warnings.catch_warnings():
            # cuDNN copies weights that are not one contiguous chunk in
            # its own order (these are views of the reference's layout)
            # and warns each call
            warnings.filterwarnings("ignore", message=".*contiguous chunk")
            if mode == "lstm":
                c0 = state_cell[layer * D:(layer + 1) * D]
                x, h_n, c_n = fn(x, (h0, c0), weights, True, 1, 0.0,
                                 octx.is_train, bidir, False)
                cs.append(c_n)
            else:
                x, h_n = fn(x, h0, weights, True, 1, 0.0, octx.is_train,
                            bidir, False)
        hs.append(h_n)
        if p_drop > 0.0 and octx.is_train and layer < L - 1:
            keep = 1.0 - p_drop
            x = x * (torch.empty_like(x).bernoulli_(
                keep, generator=octx.generator) / keep)
    outs = [x, torch.cat(hs)]
    if mode == "lstm":
        outs.append(torch.cat(cs))
    return outs, []


def _begin_state(attrs, ref):
    shape = tuple(attrs["shape"])
    n = ref.shape[attrs.get("batch_axis", 0)]
    return torch.zeros(tuple(n if s == 0 else s for s in shape),
                       dtype=ref.dtype, device=ref.device)


def _begin_state_shape(attrs, in_shapes, aux_shapes):
    ref = in_shapes[0]
    shape = tuple(attrs["shape"])
    n = ref[attrs.get("batch_axis", 0)]
    return [ref], [tuple(n if s == 0 else s for s in shape)], []


def register_all():
    # the zero initial state whose batch dim follows a reference input
    # (shape-safe under bucketing, where the batch is known at bind)
    register_op(OpDef("_rnn_begin_state", simple_compute(_begin_state),
                      schema=ParamSchema(Param("shape", "shape",
                                               required=True),
                                         Param("batch_axis", int,
                                               default=0)),
                      num_inputs=1, infer_shape=_begin_state_shape,
                      hint="begin_state"))

    register_op(OpDef(
        "RNN", _rnn,
        schema=ParamSchema(
            Param("state_size", int, required=True),
            Param("num_layers", int, required=True),
            Param("bidirectional", bool, default=False),
            Param("mode", str, required=True,
                  enum=("rnn_relu", "rnn_tanh", "lstm", "gru")),
            Param("p", float, default=0.0),
            Param("state_outputs", bool, default=False)),
        num_inputs=_num_inputs, num_outputs=_num_outputs,
        num_visible_outputs=_num_visible, arguments=_arguments,
        outputs=_outputs, infer_shape=_infer_shape, hint="rnn"))
