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
multi-tensor update (``ops/update_kernel.py``): per-index lr / wd with the
update counts bumped as the eager path bumps them, Adam's bias correction
folded into lr at the true count.
"""
from __future__ import annotations

import math

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

    def _prep_grad(self, grad, dtype):
        """The rescaled, clipped gradient in the weight's dtype."""
        g = grad.data.to(dtype) * self.rescale_grad
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
            step = (self._prep_grad(grad, w.dtype) + wd * w) * lr
            if state is not None:
                state.mul_(self.momentum).sub_(step)
                w.add_(state)
            else:
                w.sub_(step)

    def fused_extra(self):
        return np.array([self.momentum], np.float32)


@register
class ccSGD(SGD):
    """The reference's C++ SGD: the same update as :class:`SGD`."""


@register
class NAG(SGD):
    """Nesterov accelerated SGD (the multi-tensor kernel does not
    implement it: ``kind_of`` checks exact types, so NAG keeps the
    per-parameter update)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        with torch.no_grad():
            g = self._prep_grad(grad, w.dtype)
            if state is not None:
                state.mul_(self.momentum)
                g = g + wd * w
                state.add_(g)
                g = g + self.momentum * state
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

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        mean, var = state
        w = weight.data
        with torch.no_grad():
            g = self._prep_grad(grad, w.dtype) + wd * w
            mean.mul_(self.beta1).add_((1 - self.beta1) * g)
            var.mul_(self.beta2).add_((1 - self.beta2) * g.square())
            w.sub_(lr * mean / (var.sqrt() + self.epsilon))

    def fused_extra(self):
        return np.array([self.beta1, self.beta2, self.epsilon], np.float32)

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


def get_updater(optimizer):
    return Updater(optimizer)
