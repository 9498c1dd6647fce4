"""RNN cell symbol library — the port of ``mxnet_tpu/rnn/rnn_cell.py``.

Step-composable cells (``__call__``), graph unrolling (``unroll``), the
fused multi-layer ``FusedRNNCell`` (lowered to the ``RNN`` op of
``ops/rnn_op.py``) and the exact pack / unpack between its flat blob and
per-cell weights.  Names, prefixes and auto-naming are the JAX
package's, so an unrolled graph's ``tojson()`` and ``list_arguments()``
match it.  Sequence marshalling lives in ``_as_step_list`` /
``_stack_steps``, gate projections go through ``_linear``, and the two
container cells (Sequential, Bidirectional) share ``_MultiCell``.
"""
from __future__ import annotations

import numpy as np

from .. import symbol
from ..base import MXNetError
from ..initializer import FusedRNN, LSTMBias
from ..ops.rnn_op import _gates, _layout, rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


# -- sequence marshalling ----------------------------------------------------


def _as_step_list(inputs, length, layout, prefix=""):
    """Normalize ``inputs`` into a list of per-step (N, C) symbols.

    Accepts None (fresh Variables), a single merged symbol (split along the
    time axis of ``layout``), or an existing list (returned as-is).
    """
    if inputs is None:
        return [symbol.Variable("%st%d_data" % (prefix, t))
                for t in range(length)]
    if isinstance(inputs, symbol.Symbol):
        if len(inputs) != 1:
            raise MXNetError("unroll expects a single-output symbol")
        steps = symbol.SliceChannel(inputs, axis=layout.find("T"),
                                    num_outputs=length, squeeze_axis=1)
        return [steps[t] for t in range(length)]
    return list(inputs)


def _stack_steps(outputs, time_axis):
    """Merge a list of per-step symbols into one along a new time axis."""
    expanded = [symbol.expand_dims(o, axis=time_axis) for o in outputs]
    return symbol.Concat(*expanded, dim=time_axis)


def _linear(data, weight, bias, n_out, name):
    return symbol.FullyConnected(data=data, weight=weight, bias=bias,
                                 num_hidden=n_out, name=name)


# -- parameter container -----------------------------------------------------


class RNNParams:
    """Lazily-created, prefix-namespaced Variable pool shared across steps."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


# -- base cell ---------------------------------------------------------------


class BaseRNNCell:
    """Contract: ``__call__(input, states) -> (output, new_states)`` plus
    ``state_info``/``begin_state`` for state bootstrapping and
    pack/unpack_weights for fused interop."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._params = params if params is not None else RNNParams(prefix)
        self._prefix = prefix
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def _step_name(self):
        self._counter += 1
        return "%st%d_" % (self._prefix, self._counter)

    def begin_state(self, func=None, _batch_ref=None, _ref_axis=0, **kwargs):
        """Initial-state symbols.

        ``_batch_ref`` (set by unroll) produces zeros whose batch dim tracks
        a data symbol at bind time; ``func`` delegates construction; the
        default is plain Variables the caller feeds.
        """
        if self._modified:
            raise MXNetError("cell was wrapped by a modifier; use the "
                             "modifier's begin_state")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is not None:
                states.append(func(name=name, **kwargs))
            elif _batch_ref is not None:
                states.append(symbol._create(
                    "_rnn_begin_state", [_batch_ref],
                    {"shape": str(tuple(info["shape"])),
                     "batch_axis": str(_ref_axis)}, name=name))
            else:
                states.append(symbol.Variable(name))
        return states

    # fused interop: identity for plain cells
    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Step the cell ``length`` times over the time axis of ``layout``.

        Returns (outputs, final_states); outputs are a per-step list unless
        ``merge_outputs`` requests one stacked symbol.
        """
        self.reset()
        steps = _as_step_list(inputs, length, layout, input_prefix)
        states = begin_state if begin_state is not None else \
            self.begin_state(_batch_ref=steps[0], _ref_axis=0)
        outputs = []
        for step in steps:
            out, states = self(step, states)
            outputs.append(out)
        if merge_outputs:
            outputs = _stack_steps(outputs, 1)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


# -- elementary cells --------------------------------------------------------


class RNNCell(BaseRNNCell):
    """Elman cell: h' = act(W_x x + W_h h + b_x + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._w = {k: self.params.get("%s_weight" % k) for k in ("i2h", "h2h")}
        self._b = {k: self.params.get("%s_bias" % k) for k in ("i2h", "h2h")}

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_name()
        pre = _linear(inputs, self._w["i2h"], self._b["i2h"],
                      self._num_hidden, name + "i2h") \
            + _linear(states[0], self._w["h2h"], self._b["h2h"],
                      self._num_hidden, name + "h2h")
        out = self._get_activation(pre, self._activation, name=name + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM with gate order i, f, c, o (matches the fused layout)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._w = {k: self.params.get("%s_weight" % k) for k in ("i2h", "h2h")}
        self._b = {"i2h": self.params.get(
                       "i2h_bias", init=LSTMBias(forget_bias=forget_bias)),
                   "h2h": self.params.get("h2h_bias")}

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        h_prev, c_prev = states
        width = self._num_hidden * 4
        pre = _linear(inputs, self._w["i2h"], self._b["i2h"], width,
                      name + "i2h") \
            + _linear(h_prev, self._w["h2h"], self._b["h2h"], width,
                      name + "h2h")
        gate = symbol.SliceChannel(pre, num_outputs=4, axis=1,
                                   name=name + "slice")
        sigm = lambda s: symbol.Activation(s, act_type="sigmoid")
        tanh = lambda s: symbol.Activation(s, act_type="tanh")
        c_next = sigm(gate[1]) * c_prev + sigm(gate[0]) * tanh(gate[2])
        h_next = sigm(gate[3]) * tanh(c_next)
        return h_next, [h_next, c_next]


class GRUCell(BaseRNNCell):
    """GRU with gate order r, z, n (matches the fused layout)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._w = {k: self.params.get("%s_weight" % k) for k in ("i2h", "h2h")}
        self._b = {k: self.params.get("%s_bias" % k) for k in ("i2h", "h2h")}

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        h_prev = states[0]
        width = self._num_hidden * 3
        from_x = symbol.SliceChannel(
            _linear(inputs, self._w["i2h"], self._b["i2h"], width,
                    name + "i2h"),
            num_outputs=3, name=name + "i2h_slice")
        from_h = symbol.SliceChannel(
            _linear(h_prev, self._w["h2h"], self._b["h2h"], width,
                    name + "h2h"),
            num_outputs=3, name=name + "h2h_slice")
        reset = symbol.Activation(from_x[0] + from_h[0], act_type="sigmoid",
                                  name=name + "r_act")
        update = symbol.Activation(from_x[1] + from_h[1], act_type="sigmoid",
                                   name=name + "z_act")
        cand = symbol.Activation(from_x[2] + reset * from_h[2],
                                 act_type="tanh", name=name + "h_act")
        h_next = update * h_prev + (1.0 - update) * cand
        return h_next, [h_next]


# -- fused cell --------------------------------------------------------------


class FusedRNNCell(BaseRNNCell):
    """Multi-layer (optionally bidirectional) RNN backed by the fused ``RNN``
    op.  Cannot be stepped — only unrolled whole."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix="%s_" % mode if prefix is None else prefix,
                         params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        # unpack->init->repack aware initializer rides on the Variable so
        # Module.init_params initializes the packed blob correctly
        self._parameter = self.params.get(
            "parameters", init=FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias))
        self._directions = 2 if bidirectional else 1

    @property
    def state_info(self):
        layers = self._directions * self._num_layers
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": (layers, 0, self._num_hidden),
                 "__layout__": "LNC"}] * n_states

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped; use unroll()")

    # -- packed-parameter interop -------------------------------------------
    def _param_layout(self, input_size):
        return _layout(self._num_layers, self._num_hidden, self._mode,
                       self._bidirectional, input_size)

    def _infer_input_size(self, flat):
        """Invert the parameter-count formula for the input width."""
        g, d, H, L = (_gates(self._mode), self._directions,
                      self._num_hidden, self._num_layers)
        # flat.size = d*g*H*input + [first-layer h2h + upper layers + biases]
        fixed = d * g * H * H \
            + (L - 1) * d * g * H * (H * d + H) \
            + L * d * 2 * g * H
        return (int(flat.size) - fixed) // (d * g * H)

    def unpack_weights(self, args, input_size=None):
        """Flat ``parameters`` blob -> individual lX_dY_{i2h,h2h}_* arrays."""
        out = dict(args)
        flat = out.pop(self._prefix + "parameters")
        flat = np.asarray(flat.asnumpy() if hasattr(flat, "asnumpy")
                          else flat)
        if input_size is None:
            input_size = self._infer_input_size(flat)
        for name, offset, shape in self._param_layout(input_size):
            count = int(np.prod(shape))
            out[self._prefix + name] = \
                flat[offset:offset + count].reshape(shape).copy()
        return out

    def pack_weights(self, args, input_size=None):
        """Individual per-gate arrays -> flat ``parameters`` blob."""
        out = dict(args)
        pieces = {k[len(self._prefix):]: out.pop(k)
                  for k in list(out)
                  if k.startswith(self._prefix)
                  and ("_i2h_" in k or "_h2h_" in k)}

        def host(v):
            return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)

        if input_size is None:
            input_size = host(pieces["l0_d0_i2h_weight"]).shape[-1]
        flat = np.zeros(rnn_param_size(self._num_layers, self._num_hidden,
                                       self._mode, self._bidirectional,
                                       input_size),
                        dtype=host(next(iter(pieces.values()))).dtype)
        for name, offset, shape in self._param_layout(input_size):
            count = int(np.prod(shape))
            flat[offset:offset + count] = host(pieces[name]).reshape(-1)
        out[self._prefix + "parameters"] = flat
        return out

    # -- graph construction ---------------------------------------------------
    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        time_axis = layout.find("T")
        # the RNN op wants TNC; merge lists ourselves along axis 0
        if inputs is None or isinstance(inputs, list):
            steps = _as_step_list(inputs, length, layout, input_prefix)
            seq = _stack_steps(steps, 0)
        elif time_axis == 1:
            seq = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        else:
            seq = inputs
        states = begin_state if begin_state is not None else \
            self.begin_state(_batch_ref=seq, _ref_axis=1)

        rnn = symbol.RNN(seq, self._parameter, *states,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, mode=self._mode,
                         p=self._dropout, state_outputs=self._get_next_state,
                         name="%srnn" % self._prefix)

        if self._get_next_state:
            outputs = rnn[0]
            next_states = [rnn[i + 1]
                           for i in range(len(self.state_info))]
        else:
            outputs = rnn if len(rnn) == 1 else rnn[0]
            next_states = []

        if time_axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if not merge_outputs:
            split = symbol.SliceChannel(outputs, axis=time_axis,
                                        num_outputs=length, squeeze_axis=1)
            outputs = [split[t] for t in range(length)]
        return outputs, next_states

    def unfuse(self):
        """Equivalent stack of unfused cells (prefixes line up with the
        packed layout, so weights transfer via pack/unpack)."""
        factories = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }
        make = factories[self._mode]
        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_d0_" % (self._prefix, layer)),
                    make("%sl%d_d1_" % (self._prefix, layer)),
                    output_prefix="%sbi_l%d_" % (self._prefix, layer)))
            else:
                stack.add(make("%sl%d_d0_" % (self._prefix, layer)))
            if self._dropout > 0 and layer + 1 < self._num_layers:
                stack.add(DropoutCell(
                    self._dropout,
                    prefix="%s_dropout%d_" % (self._prefix, layer)))
        return stack


# -- container cells ---------------------------------------------------------


class _MultiCell(BaseRNNCell):
    """Shared machinery for cells made of child cells: parameter merging,
    state fan-out, and pack/unpack delegation."""

    def __init__(self, params=None, prefix=""):
        super().__init__(prefix=prefix, params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def _adopt(self, cell):
        if self._override_cell_params:
            if not cell._own_params:
                raise MXNetError("give params to the container or to the "
                                 "child cells, not both")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)
        self._cells.append(cell)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("cell was wrapped by a modifier; use the "
                             "modifier's begin_state")
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def _split_states(self, states):
        """Slice a flat state list into per-child chunks."""
        chunks, pos = [], 0
        for cell in self._cells:
            width = len(cell.state_info)
            chunks.append(states[pos:pos + width] if states is not None
                          else None)
            pos += width
        return chunks

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args


class SequentialRNNCell(_MultiCell):
    """Vertical stack: each child consumes the previous child's output."""

    def __init__(self, params=None):
        super().__init__(params=params)

    def add(self, cell):
        self._adopt(cell)

    def __call__(self, inputs, states):
        self._counter += 1
        new_states = []
        for cell, chunk in zip(self._cells, self._split_states(list(states))):
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("BidirectionalCell cannot be stepped inside "
                                 "SequentialRNNCell; unroll instead")
            inputs, out_states = cell(inputs, chunk)
            new_states.extend(out_states)
        return inputs, new_states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        # layer-wise unroll so Fused/Bidirectional children work
        self.reset()
        outputs = inputs
        final_states = []
        chunks = self._split_states(begin_state)
        last = len(self._cells) - 1
        for i, (cell, chunk) in enumerate(zip(self._cells, chunks)):
            outputs, states = cell.unroll(
                length, inputs=outputs, begin_state=chunk,
                input_prefix=input_prefix, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            final_states.extend(states)
        return outputs, final_states


class BidirectionalCell(_MultiCell):
    """Runs one child forward and one backward over time, concatenating the
    per-step outputs on the feature axis."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(params=params)
        self._output_prefix = output_prefix
        self._adopt(l_cell)
        self._adopt(r_cell)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        steps = _as_step_list(inputs, length, layout, input_prefix)
        fwd_cell, bwd_cell = self._cells
        fwd_begin, bwd_begin = self._split_states(begin_state)
        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=steps, begin_state=fwd_begin, layout=layout,
            merge_outputs=False)
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=steps[::-1], begin_state=bwd_begin, layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(f, b, dim=1,
                                 name="%st%d" % (self._output_prefix, t))
                   for t, (f, b) in enumerate(zip(fwd_out, bwd_out[::-1]))]
        if merge_outputs:
            outputs = _stack_steps(outputs, 1)
        return outputs, fwd_states + bwd_states


# -- pass-through / wrapper cells ---------------------------------------------


class DropoutCell(BaseRNNCell):
    """Stateless dropout between stacked layers."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        # a merged symbol can be masked in one shot
        if isinstance(inputs, symbol.Symbol) and merge_outputs is not False:
            out, _ = self(inputs, [])
            return out, []
        return super().unroll(length, inputs, begin_state, input_prefix,
                              layout, merge_outputs)


class ModifierCell(BaseRNNCell):
    """Wraps a base cell, borrowing its params/states; subclasses override
    ``__call__`` to decorate the step function."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=None, **kwargs):
        if self._modified:
            raise MXNetError("doubly-modified cell; unwrap first")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(**kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al.): randomly carry previous outputs/states
    through instead of the new values."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise MXNetError("zoneout needs per-step access; unfuse() the "
                             "FusedRNNCell first")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    @staticmethod
    def _carry(p, new, old):
        """new where a Bernoulli(1-p) mask fires, else old."""
        keep_mask = symbol.Dropout(symbol.ones_like(new), p=p)
        return symbol.where(keep_mask, new, old)

    def __call__(self, inputs, states):
        new_output, new_states = self.base_cell(inputs, states)
        prev = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(new_output)
        output = self._carry(self.zoneout_outputs, new_output, prev) \
            if self.zoneout_outputs else new_output
        if self.zoneout_states:
            new_states = [self._carry(self.zoneout_states, s_new, s_old)
                          for s_new, s_old in zip(new_states, states)]
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the cell input to its output (He-style skip over the step)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states
