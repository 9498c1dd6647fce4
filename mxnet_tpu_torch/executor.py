"""Executor — a bound symbol: argument, gradient and auxiliary arrays plus
a forward/backward over the graph (the counterpart of
``mxnet_tpu/executor.py``'s ``Executor`` and ``simple_bind``).

The graph runs eagerly, node by node, as the decode walk does: each op's
``fcompute`` on torch tensors, the hand-written kernels inside the ops.
A training forward runs under autograd with every parameter whose
``grad_req`` is not "null" as a leaf; :meth:`Executor.backward` seeds the
outputs with ones (loss heads such as SoftmaxOutput ignore the seed) and
writes the gradients into ``grad_dict``.  Aux states and gradients are
written into their arrays IN PLACE, so the tensors a captured train step
binds by pointer (``train_step.CompiledTrainStep``) stay the arrays'
storage whichever path ran last.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import NDArray, zeros
from .registry import OpContext

__all__ = ["Executor", "simple_bind"]


def run_graph(symbol, env_args, env_aux, octx):
    """Execute ``symbol`` on tensors; returns ``(outputs, new_aux)``.
    ``env_args``/``env_aux`` map variable names to tensors."""
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
        for (anode, _), val in zip(node.inputs[n_args:], node_new_aux):
            new_aux[anode.name] = val
    return [values[(id(n), i)] for n, i in symbol._outputs], new_aux


def forward_backward(symbol, env_args, env_aux, grad_names, octx):
    """One training pass: forward under autograd with ``grad_names`` as
    leaves, then their gradients from ones seeded at the outputs.
    Returns ``(outputs, new_aux, grads)``, outputs detached."""
    env = dict(env_args)
    leaves = [env[n].detach().requires_grad_(True) for n in grad_names]
    env.update(zip(grad_names, leaves))
    with torch.enable_grad():
        outs, new_aux = run_graph(symbol, env, env_aux, octx)
        grads = torch.autograd.grad(outs, leaves,
                                    [torch.ones_like(o) for o in outs],
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return ([o.detach() for o in outs],
            {n: v.detach() for n, v in new_aux.items()}, grads)


class Executor:
    """A symbol bound to arrays on one device.

    ``arg_dict``/``grad_dict``/``aux_dict`` map names to
    :class:`~mxnet_tpu_torch.ndarray.NDArray`; ``grad_req`` is "write" or
    "null" per argument ("add" is not ported).  ``plain`` runs every op
    that owns a kernel through its plain version.  ``generator`` (a
    ``torch.Generator`` on the device, None for torch's default one) is
    what Dropout and the RNN op's dropout draw their masks from."""

    def __init__(self, symbol, device, args, args_grad=None,
                 grad_req="write", aux_states=None, plain=False):
        self._symbol = symbol
        self.plain = plain
        self.generator = None
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.arg_dict = ({n: args[n] for n in arg_names}
                         if isinstance(args, dict)
                         else dict(zip(arg_names, args)))
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        else:
            self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        self.grad_dict = dict(args_grad or {})
        for n in arg_names:
            req = self.grad_req[n]
            if req not in ("null", "write"):
                raise MXNetError("grad_req %r for %s is not supported "
                                 "(null/write only)" % (req, n))
            if req != "null" and n not in self.grad_dict:
                self.grad_req[n] = "null"
        aux_states = aux_states or {}
        self.aux_dict = ({n: aux_states[n] for n in aux_names}
                         if isinstance(aux_states, dict)
                         else dict(zip(aux_names, aux_states)))
        self._aux_names = aux_names
        self._grad_names = [n for n in arg_names
                            if self.grad_req[n] != "null"]
        self._outputs = None
        self._grads = None

    def _env(self):
        return ({n: a.data for n, a in self.arg_dict.items()},
                {n: a.data for n, a in self.aux_dict.items()})

    def op_context(self, is_train):
        return OpContext(is_train=is_train, plain=self.plain,
                         generator=self.generator)

    def _set_aux(self, new_aux):
        with torch.no_grad():
            for n in self._aux_names:
                self.aux_dict[n].data.copy_(new_aux[n])

    def forward(self, is_train=False):
        """Run the graph; with ``is_train`` also compute the gradients that
        :meth:`backward` stores."""
        env_args, env_aux = self._env()
        if is_train and self._grad_names:
            outs, new_aux, self._grads = forward_backward(
                self._symbol, env_args, env_aux, self._grad_names,
                self.op_context(True))
        else:
            with torch.no_grad():
                outs, new_aux = run_graph(self._symbol, env_args, env_aux,
                                          self.op_context(is_train))
            self._grads = None
        self._set_aux(new_aux)
        self._outputs = [NDArray(o) for o in outs]
        return self._outputs

    def backward(self):
        """Store the gradients of the last training forward (seeded with
        ones at the outputs, as ``train_step.py`` seeds them) in
        ``grad_dict``."""
        if not self._grad_names:
            return
        if self._grads is None:
            raise MXNetError("backward() called before forward(is_train=True)")
        self.set_grads(self._grads)
        self._grads = None

    def set_grads(self, grads):
        """Write gradients (in ``grad_req`` order) into ``grad_dict``'s
        arrays, in place and in each array's dtype."""
        with torch.no_grad():
            for n, g in zip(self._grad_names, grads):
                self.grad_dict[n].data.copy_(g)

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("Executor has not been run")
        return self._outputs

    def set_outputs(self, outs):
        self._outputs = [NDArray(o) for o in outs]


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
