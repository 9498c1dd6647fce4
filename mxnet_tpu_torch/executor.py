"""Executor — a bound symbol: argument, gradient and auxiliary arrays plus
a forward/backward over the graph (the counterpart of
``mxnet_tpu/executor.py``'s ``Executor`` and ``simple_bind``).

The graph runs node by node, as the decode walk does: each op's
``fcompute`` on torch tensors, the hand-written kernels inside the ops.
A training forward runs under autograd with every parameter whose
``grad_req`` is not "null" as a leaf; :meth:`Executor.backward` writes
the gradients into ``grad_dict`` (adds them under ``grad_req`` "add"),
seeded with ones at the outputs (loss heads such as SoftmaxOutput
ignore the seed) or, given ``out_grads``, with the caller's head
gradients (the forward is run again from the generator state the first
one drew from, so Dropout's masks repeat).
An inference forward (``is_train=False``) replays one captured program
per executor (:class:`~mxnet_tpu_torch.train_step.CompiledForward`,
the counterpart of the JAX package's jitted ``fwd_test``) unless
``programs.eager()`` is on, a monitor tap is armed or the graph holds a
node no program may capture (a Custom op); a monitored run is eager and
calls the tap with every node's outputs by name.  Aux
states and gradients are written into their arrays IN PLACE, so the
tensors a captured program binds by pointer stay the arrays' storage
whichever path ran last.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray, _device, zeros
from .registry import OpContext

__all__ = ["Executor", "simple_bind"]


def uncapturable_ops(symbol):
    """The names of ``symbol``'s nodes whose op may read values back to
    the host (``OpDef.capturable`` False: Custom), which no captured
    program may hold."""
    return [n.name for n in symbol._topo()
            if not n.is_variable and not n.op.capturable]


def run_graph(symbol, env_args, env_aux, octx, tap=None):
    """Execute ``symbol`` on tensors; returns ``(outputs, new_aux)``.
    ``env_args``/``env_aux`` map variable names to tensors.  ``tap(name,
    tensor)``, when given, sees every node's visible outputs, named
    ``<node>_<output>`` (the monitor's callback)."""
    values = {}
    new_aux = dict(env_aux)
    for node in symbol._topo():
        if node.is_variable:
            src = env_aux if node.is_aux_var else env_args
            if node.name not in src:
                raise MXNetError("no value bound for %r" % node.name)
            values[(id(node), 0)] = src[node.name]
            continue
        attrs = node.parsed_attrs()
        n_args = node.op.n_inputs(attrs)
        ins = [values[(id(s), i)] for s, i in node.inputs[:n_args]]
        aux_ins = [values[(id(s), i)] for s, i in node.inputs[n_args:]]
        outs, node_new_aux = node.op.fcompute(attrs, ins, aux_ins, octx)
        for i, o in enumerate(outs):
            values[(id(node), i)] = o
        if tap is not None:
            names = node.op.list_outputs(attrs)
            for i in range(node.op.n_visible_outputs(attrs)):
                tap("%s_%s" % (node.name, names[i] if i < len(names)
                               else i), outs[i])
        for (anode, _), val in zip(node.inputs[n_args:], node_new_aux):
            new_aux[anode.name] = val
    return [values[(id(n), i)] for n, i in symbol._outputs], new_aux


def forward_backward(symbol, env_args, env_aux, grad_names, octx,
                     head_grads=None, tap=None):
    """One training pass: forward under autograd with ``grad_names`` as
    leaves, then their gradients from ``head_grads`` seeded at the
    outputs (ones when None); outputs no gradient reaches (BlockGrad's)
    are skipped.  Returns ``(outputs, new_aux, grads)``, outputs
    detached."""
    from .autograd import _grads

    env = dict(env_args)
    leaves = [env[n].detach().requires_grad_(True) for n in grad_names]
    env.update(zip(grad_names, leaves))
    with torch.enable_grad():
        outs, new_aux = run_graph(symbol, env, env_aux, octx, tap)
        seeds = [torch.ones_like(o) for o in outs] if head_grads is None \
            else [g.to(o.device, o.dtype) for g, o in zip(head_grads, outs)]
        grads = _grads(outs, seeds, leaves, retain_graph=False)
    return ([o.detach() for o in outs],
            {n: v.detach() for n, v in new_aux.items()}, grads)


class Executor:
    """A symbol bound to arrays on one device.

    ``arg_dict``/``grad_dict``/``aux_dict`` map names to
    :class:`~mxnet_tpu_torch.ndarray.NDArray` (``arg_arrays`` /
    ``grad_arrays`` / ``aux_arrays`` list them in the symbol's order);
    ``grad_req`` is "write", "add" (each backward adds its gradient into
    the buffer, which only the caller zeroes) or "null" per argument.
    ``plain`` runs every op that owns a kernel through its
    plain version.  ``generator`` (a ``torch.Generator`` on the device,
    None for torch's default one) is what Dropout and the RNN op's
    dropout draw their masks from."""

    def __init__(self, symbol, device, args, args_grad=None,
                 grad_req="write", aux_states=None, plain=False):
        self._symbol = symbol
        self._device = _device(device)
        self.plain = plain
        self.generator = None
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if not isinstance(args, dict) and len(args) != len(arg_names):
            raise MXNetError("Length of args does not match arguments: %s"
                             % arg_names)
        self.arg_dict = ({n: args[n] for n in arg_names}
                         if isinstance(args, dict)
                         else dict(zip(arg_names, args)))
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        if args_grad is None or isinstance(args_grad, dict):
            self.grad_dict = dict(args_grad or {})
        else:
            self.grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                              if g is not None}
        for n in arg_names:
            req = self.grad_req[n]
            if req not in ("null", "write", "add"):
                raise MXNetError("grad_req %r for %s is not one of null, "
                                 "write, add" % (req, n))
            if req != "null" and n not in self.grad_dict:
                self.grad_req[n] = "null"
        aux_states = aux_states or {}
        self.aux_dict = ({n: aux_states[n] for n in aux_names}
                         if isinstance(aux_states, dict)
                         else dict(zip(aux_names, aux_states)))
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._grad_names = [n for n in arg_names
                            if self.grad_req[n] != "null"]
        self._outputs = None
        self._grads = None
        self._last_gen_state = None   # the last training forward's
        self._monitor_callback = None
        self._compiled_forward = None
        self._capturable = not uncapturable_ops(symbol)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def _env(self):
        return ({n: a.data for n, a in self.arg_dict.items()},
                {n: a.data for n, a in self.aux_dict.items()})

    def op_context(self, is_train):
        return OpContext(is_train=is_train, plain=self.plain,
                         generator=self.generator, device=self._device)

    def _set_aux(self, new_aux):
        with torch.no_grad():
            for n in self._aux_names:
                self.aux_dict[n].data.copy_(new_aux[n])

    def _generator_state(self):
        """The generator the random ops draw from (torch's default one of
        the device when ``generator`` is None) and its state now."""
        gen = self.generator
        if gen is None:
            dev = self._device
            gen = torch.cuda.default_generators[dev.index or 0] \
                if dev.type == "cuda" else torch.default_generator
        return gen, gen.get_state()

    def _tap(self):
        """The monitor's callback as a tap on tensors, or None when no
        monitor is installed or it is not collecting."""
        cb = self._monitor_callback
        if cb is None or not getattr(cb, "active", True):
            return None
        return lambda name, value: cb(name, NDArray(value.detach()))

    def forward(self, is_train=False, **kwargs):
        """Run the graph; with ``is_train`` also compute the gradients
        that :meth:`backward` stores.  ``kwargs`` are copied into the
        named arguments first."""
        from . import programs
        from .train_step import CompiledForward

        for name, value in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("Unknown argument %s" % name)
            self.arg_dict[name][:] = value
        env_args, env_aux = self._env()
        tap = self._tap()
        if is_train:
            self._last_gen_state = self._generator_state()[1]
        if is_train and self._grad_names:
            outs, new_aux, self._grads = forward_backward(
                self._symbol, env_args, env_aux, self._grad_names,
                self.op_context(True), tap=tap)
        elif (is_train or tap is not None or programs.graphs.eager_active()
              or not (self.arg_dict or self.aux_dict)
              or not self._capturable):
            # a graph without arrays gives a program nothing to bind;
            # a Custom node's Python body cannot be captured
            with torch.no_grad():
                outs, new_aux = run_graph(self._symbol, env_args, env_aux,
                                          self.op_context(is_train), tap)
            self._grads = None
        else:
            if self._compiled_forward is None:
                self._compiled_forward = CompiledForward(self)
            self._outputs = [NDArray(o)
                             for o in self._compiled_forward.run()]
            self._grads = None
            return self._outputs
        self._set_aux(new_aux)
        self._outputs = [NDArray(o) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Store the gradients of the last training forward in
        ``grad_dict``: seeded with ones at the outputs (as
        ``train_step.py`` seeds them), or with ``out_grads`` (an NDArray
        or a list, one an output), for which the forward runs again from
        the generator state the last one started from (the same Dropout
        masks); its aux updates are not written a second time."""
        if not self._grad_names:
            return
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [g.data if isinstance(g, NDArray) else g
                     for g in out_grads]
            gen, now = self._generator_state()
            if self._last_gen_state is not None:
                gen.set_state(self._last_gen_state)
            try:
                env_args, env_aux = self._env()
                _, _, grads = forward_backward(
                    self._symbol, env_args, env_aux, self._grad_names,
                    self.op_context(True), head_grads=heads)
            finally:
                gen.set_state(now)
        else:
            if self._grads is None:
                raise MXNetError("backward() called before "
                                 "forward(is_train=True)")
            grads = self._grads
        self.set_grads(grads)
        self._grads = None

    def set_grads(self, grads):
        """Write gradients (in ``grad_req`` order) into ``grad_dict``'s
        arrays — added to them under "add" — in place and in each
        array's dtype."""
        with torch.no_grad():
            for n, g in zip(self._grad_names, grads):
                buf = self.grad_dict[n].data
                if self.grad_req[n] == "add":
                    buf.add_(g.to(buf.dtype))
                else:
                    buf.copy_(g)

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("Executor has not been run")
        return self._outputs

    def set_outputs(self, outs):
        self._outputs = [NDArray(o) for o in outs]

    def set_monitor_callback(self, callback):
        """Call ``callback(name, NDArray)`` with every node's outputs in
        each forward while it is active (``callback.active``, when it has
        one); a monitored forward runs eagerly."""
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameters (NDArrays, tensors or numpy) into the bound
        arrays in place; a name the symbol lacks raises unless
        ``allow_extra_params``."""
        for table, params, what in ((self.arg_dict, arg_params, "arguments"),
                                    (self.aux_dict, aux_params or {},
                                     "aux states")):
            for name, array in params.items():
                if name in table:
                    table[name][:] = array
                elif not allow_extra_params:
                    raise MXNetError("Found name %r not in %s"
                                     % (name, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new Executor for new input shapes (``kwargs``), sharing every
        array whose shape is unchanged by identity; the rest are new
        zeroed arrays.  An argument not named in ``kwargs`` may change
        shape only with ``partial_shaping``, and an array may grow only
        with ``allow_up_sizing`` (the JAX package's contract)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args, new_grads = {}, {}
        for name, shape in zip(self._arg_names, arg_shapes):
            arr = self.arg_dict[name]
            if tuple(shape) == arr.shape:
                new_args[name] = arr
                if name in self.grad_dict:
                    new_grads[name] = self.grad_dict[name]
                continue
            if not partial_shaping and name not in kwargs:
                raise MXNetError(
                    "Shape of unspecified argument %r changed (%s -> %s); "
                    "pass partial_shaping=True to allow this"
                    % (name, arr.shape, tuple(shape)))
            if not allow_up_sizing and \
                    int(np.prod(shape)) > int(np.prod(arr.shape)):
                raise MXNetError(
                    "New shape of %r is larger than the original (%s -> "
                    "%s); pass allow_up_sizing=True to allow this"
                    % (name, arr.shape, tuple(shape)))
            new_args[name] = zeros(shape, self._device, arr.data.dtype)
            if name in self.grad_dict:
                new_grads[name] = zeros(shape, self._device,
                                        self.grad_dict[name].data.dtype)
        new_aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            arr = self.aux_dict[name]
            new_aux[name] = arr if tuple(shape) == arr.shape else \
                zeros(shape, self._device, arr.data.dtype)
        exe = Executor(self._symbol, self._device, new_args, new_grads,
                       self.grad_req, new_aux, plain=self.plain)
        exe.generator = self.generator
        return exe


def simple_bind(symbol, device, grad_req="write", type_dict=None,
                plain=False, shared_exec=None, **shapes):
    """Allocate zeroed argument, gradient and aux arrays on ``device``
    from the input ``shapes`` and bind them.  ``grad_req`` is a string or
    a per-name dict; ``type_dict`` gives input dtypes (default f32).
    With ``shared_exec``, every argument (with its gradient) and aux
    state that it holds under the same name and shape is taken from it
    by identity — the same NDArray, so a later rebinding of its tensor
    reaches both executors (bucketing); the rest is allocated."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    type_dict = type_dict or {}
    req = ({n: grad_req for n in arg_names} if isinstance(grad_req, str)
           else {n: grad_req.get(n, "null") for n in arg_names})

    def take(table, name, shape, dtype):
        arr = getattr(shared_exec, table, {}).get(name)
        if arr is not None and arr.shape == tuple(shape):
            return arr
        return zeros(shape, device, dtype)

    args, grads = {}, {}
    for name, shape in zip(arg_names, arg_shapes):
        dtype = type_dict.get(name)
        args[name] = take("arg_dict", name, shape, dtype)
        if req[name] != "null":
            grads[name] = take("grad_dict", name, shape, dtype)
    aux = {name: take("aux_dict", name, shape, type_dict.get(name))
           for name, shape in zip(aux_names, aux_shapes)}
    return Executor(symbol, device, args, grads, req, aux, plain=plain)
