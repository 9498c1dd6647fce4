"""Optimizers: :class:`Optimizer`, :class:`SGD`, :class:`ccSGD`,
:class:`NAG`, :class:`Adam`, :class:`Updater`, :func:`get_updater` and
:func:`create` (the counterparts of ``mxnet_tpu/optimizer.py``'s).

Each ``update`` is the JAX package's eager form written as torch ops that
update the weight and the state IN PLACE under ``torch.no_grad()`` (the
JAX package returns new arrays; the port saves the copy).  SGD::

    g = clip(g * rescale_grad);  m = momentum * m - lr * (g + wd * w);
    w = w + m                     (w = w - lr * (g + wd * w) without momentum)

Learning rate and weight decay per parameter follow the reference's
``lr_mult``/``wd_mult`` rules (symbol ``__lr_mult__`` / ``__wd_mult__``
attrs, then the dicts, by index or by name); an ``lr_scheduler`` maps the
update count to the base rate.  :meth:`Optimizer.fused_hyper` and
:meth:`Optimizer.fused_extra` are the host-side hyperparameters of the
compiled train step (``train_step.CompiledTrainStep``) and its
multi-tensor update (``ops/update_kernel.py``): per-index lr / wd with the
update counts bumped as the eager path bumps them, Adam's bias correction
folded into lr at the true count, computed once a step OUTSIDE the
captured body.  Each optimizer has ONE arithmetic body, :meth:`apply`,
which updates a weight and its slots in place: the eager ``update`` does
the host bookkeeping (count, lr, wd) and calls it with floats, and
:meth:`Optimizer.fused_kernel` hands it to the compiled step, which runs
it per parameter where the slab plan declines (NAG, masters that are not
f32 / bf16) with lr / wd as device scalars refreshed before each replay.
``Updater.get_states`` / ``set_states`` and ``pack_state`` speak the
JAX package's fused ``.states`` format: a pickled dict of tuples of numpy
arrays keyed by parameter name (or index).
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "Updater", "create",
           "get_updater", "register"]


class Optimizer:
    """Base optimizer: update counts and per-parameter lr / wd."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.sym_lr_mult = {}
        self.sym_wd_mult = {}
        if sym is not None:
            attr = sym.attr_dict()
            for name in sym.list_arguments():
                if "__lr_mult__" in attr.get(name, {}):
                    self.sym_lr_mult[name] = float(attr[name]["__lr_mult__"])
                if "__wd_mult__" in attr.get(name, {}):
                    self.sym_wd_mult[name] = float(attr[name]["__wd_mult__"])

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        """One step on ``weight`` (an NDArray, updated in place) from
        ``grad`` (NDArray); ``state`` is ``create_state``'s value."""
        self._update_count(index)
        with torch.no_grad():
            self.apply(weight.data, grad.data, _state_tensors(state),
                       self._step_lr(index), self._get_wd(index))

    def apply(self, w, g, slots, lr, wd):
        """The update's arithmetic: ``w`` and the ``slots`` tuple updated
        in place from the raw gradient ``g``; ``lr`` / ``wd`` floats or
        device scalars (lr scheduled and bias-corrected on the host)."""
        raise NotImplementedError()

    def update_multi(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # reference convention: no weight decay on bias/gamma/beta
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, base, sym_mult, mult):
        name = self.idx2name.get(index,
                                 index if isinstance(index, str) else None)
        if name is not None and name in sym_mult:
            base *= sym_mult[name]
        if index in mult:
            base *= mult[index]
        elif name is not None and name in mult:
            base *= mult[name]
        return base

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return self._mult(index, base, self.sym_lr_mult, self.lr_mult)

    def _get_wd(self, index):
        return self._mult(index, self.wd, self.sym_wd_mult, self.wd_mult)

    def _step_lr(self, index):
        """The lr ``apply`` takes for ``index`` at its current count."""
        return self._get_lr(index)

    def _prep_grad(self, g, dtype):
        """The rescaled, clipped gradient in the weight's dtype."""
        g = g.to(dtype) * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    # -- host-side hyperparameters of the multi-tensor update -------------
    def fused_hyper(self, indices):
        """Bump the update counts of ``indices`` as the eager path does and
        return ``(lrs, wds, rescale, clip)``: one f32 lr / wd per index,
        f32 scalars (clip -1 means none)."""
        for idx in indices:
            self._update_count(idx)
        lrs = np.array([self._get_lr(i) for i in indices], np.float32)
        wds = np.array([self._get_wd(i) for i in indices], np.float32)
        clip = np.float32(self.clip_gradient
                          if self.clip_gradient is not None else -1.0)
        return lrs, wds, np.float32(self.rescale_grad), clip

    def fused_extra(self):
        """The optimizer's extra hyper vector (momentum / betas /
        epsilon), re-read every step."""
        return np.zeros(0, np.float32)

    def fused_kernel(self):
        """The compiled step's per-parameter update, :meth:`apply`, or
        None (Module then keeps the eager path).  The floats it reads
        from the optimizer (rescale, clip, momentum / betas / epsilon)
        are part of the step program's signature."""
        return None

    def pack_state(self, arrays):
        """A ``create_state``-shaped value from a flat list of state
        arrays: 0 -> None, 1 -> the array, n -> a tuple."""
        if not arrays:
            return None
        if len(arrays) == 1:
            return arrays[0]
        return tuple(arrays)


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum, weight decay, rescale and clipping."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight.data)

    def apply(self, w, g, slots, lr, wd):
        step = (self._prep_grad(g, w.dtype) + wd * w) * lr
        if slots:
            slots[0].mul_(self.momentum).sub_(step)
            w.add_(slots[0])
        else:
            w.sub_(step)

    def fused_extra(self):
        return np.array([self.momentum], np.float32)

    def fused_kernel(self):
        return self.apply


@register
class ccSGD(SGD):
    """The reference's C++ SGD: the same update as :class:`SGD`."""


@register
class NAG(SGD):
    """Nesterov accelerated SGD (the multi-tensor kernel does not
    implement it: ``kind_of`` checks exact types, so NAG keeps the
    per-parameter update)."""

    def apply(self, w, g, slots, lr, wd):
        g = self._prep_grad(g, w.dtype)
        if slots:
            (m,) = slots
            m.mul_(self.momentum)
            g = g + wd * w
            m.add_(g)
            g = g + self.momentum * m
            w.add_(-lr * g)
        else:
            w.add_(-lr * (g + wd * w))


@register
class Adam(Optimizer):
    """Adam; the bias correction folds into lr at the parameter's update
    count t, as the JAX package's eager ``update`` folds it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight.data), torch.zeros_like(weight.data))

    def _step_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) * (math.sqrt(1.0 - self.beta2 ** t)
                                      / (1.0 - self.beta1 ** t))

    def apply(self, w, g, slots, lr, wd):
        mean, var = slots
        g = self._prep_grad(g, w.dtype) + wd * w
        mean.mul_(self.beta1).add_((1 - self.beta1) * g)
        var.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        w.sub_(lr * mean / (var.sqrt() + self.epsilon))

    def fused_extra(self):
        return np.array([self.beta1, self.beta2, self.epsilon], np.float32)

    def fused_kernel(self):
        return self.apply

    def fused_hyper(self, indices):
        lrs, wds, rescale, clip = super().fused_hyper(indices)
        # the bias correction at each parameter's TRUE count t, host side
        for i, idx in enumerate(indices):
            t = self._index_update_count[idx]
            lrs[i] *= math.sqrt(1.0 - self.beta2 ** t) \
                / (1.0 - self.beta1 ** t)
        return lrs, wds, rescale, clip


create = Optimizer.create_optimizer


class Updater:
    """Applies an optimizer to (index, grad, weight) triples, holding
    each parameter's state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_multi(self, indices, grads, weights):
        for index, weight in zip(indices, weights):
            if index not in self.states:
                self.states[index] = self.optimizer.create_state(index,
                                                                 weight)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])

    def get_states(self):
        """The states as the fused ``.states`` payload: a pickled dict of
        tuples of numpy arrays (bf16 as f32), keyed by parameter name
        where the optimizer knows it, else by index."""
        names = self.optimizer.idx2name
        host = {}
        for idx, state in self.states.items():
            host[names.get(idx, idx)] = tuple(
                _to_numpy(t) for t in _state_tensors(state))
        return pickle.dumps(host)

    def set_states(self, payload):
        """Load a ``.states`` payload (name- or index-keyed tuples of
        arrays), copying into existing states in place: a state may be a
        view of the train step's slot slab."""
        loaded = pickle.loads(payload)
        name2idx = {n: i for i, n in self.optimizer.idx2name.items()}
        for key, state in loaded.items():
            idx = name2idx.get(key, key) if isinstance(key, str) else key
            if isinstance(idx, str):
                logging.warning(
                    "optimizer state key %r has no index mapping; its "
                    "saved state will not be applied", key)
                continue
            arrays = list(_state_tensors(state))
            current = self.states.get(idx)
            if current is None:
                self.states[idx] = self.optimizer.pack_state(
                    [torch.as_tensor(np.asarray(a)).clone()
                     for a in arrays])
                continue
            for dst, src in zip(_state_tensors(current), arrays):
                with torch.no_grad():
                    dst.copy_(torch.as_tensor(np.asarray(src)))


def _state_tensors(state):
    """A state's arrays as a tuple (None -> (), one array -> 1-tuple)."""
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


def _to_numpy(t):
    if isinstance(t, np.ndarray):
        return t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def get_updater(optimizer):
    return Updater(optimizer)
