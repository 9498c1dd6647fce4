"""Optimizers: :class:`Optimizer`, :class:`SGD`, :class:`Updater`,
:func:`get_updater` and :func:`create` (the counterparts of
``mxnet_tpu/optimizer.py``'s).

SGD's step is the JAX package's functional form (``SGD.fused_kernel``'s
``apply``)::

    g = clip(g * rescale_grad);  m = momentum * m - lr * (g + wd * w);
    w = w + m                     (w = w - lr * (g + wd * w) without momentum)

written as torch ops that update the weight and the momentum IN PLACE
under ``torch.no_grad()``: the JAX package returns new arrays, the port
saves the copy.  Learning rate and weight decay per parameter follow the
reference's ``lr_mult``/``wd_mult`` rules (symbol ``__lr_mult__`` /
``__wd_mult__`` attrs, then the dicts, by index or by name).
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Updater", "create", "get_updater",
           "register"]


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
        if lr_scheduler is not None:
            raise NotImplementedError("lr_scheduler is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
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
        return self._mult(index, self.lr, self.sym_lr_mult, self.lr_mult)

    def _get_wd(self, index):
        return self._mult(index, self.wd, self.sym_wd_mult, self.wd_mult)


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

    def update(self, index, weight, grad, state):
        """One step on ``weight`` (an NDArray, updated in place) from
        ``grad`` (NDArray); ``state`` is the momentum tensor or None."""
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        with torch.no_grad():
            g = grad.data.to(w.dtype) * self.rescale_grad
            if self.clip_gradient is not None and self.clip_gradient > 0:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            step = (g + wd * w) * lr
            if state is not None:
                state.mul_(self.momentum).sub_(step)
                w.add_(state)
            else:
                w.sub_(step)


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


def get_updater(optimizer):
    return Updater(optimizer)
