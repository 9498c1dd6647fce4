"""Optimizers: :class:`Optimizer`, :class:`SGD`, :class:`ccSGD`,
:class:`NAG`, :class:`Adam`, :class:`AdaGrad`, :class:`RMSProp`,
:class:`AdaDelta`, :class:`Ftrl`, :class:`SGLD`, :class:`DCASGD`,
:class:`Test`, :class:`Updater`, :func:`get_updater` and :func:`create`
(the counterparts of ``mxnet_tpu/optimizer.py``'s).

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
it per parameter where the slab plan declines (NAG, AdaGrad, RMSProp,
masters that are not f32 / bf16) with lr / wd as device scalars
refreshed before each replay.  AdaDelta, Ftrl, SGLD, DCASGD and Test
have no ``fused_kernel``, as in the JAX package: a Module keeps the
eager update for them.  Each body repeats the JAX package's eager
arithmetic in its order, the constants (``1 - rho``) rounded from
Python floats as its eager update rounds them.
``Updater.get_states`` / ``set_states`` and ``pack_state`` speak the
JAX package's fused ``.states`` format: a pickled dict of tuples of numpy
arrays keyed by parameter name (or index).
"""
from __future__ import annotations

import io
import logging
import math
import pickle

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "SGLD", "DCASGD", "Test", "Updater",
           "create", "get_updater", "register"]


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


def _zeros(weight):
    """An f32 state the shape of ``weight`` on its device (the JAX
    package's ``zeros(weight.shape, weight.context)``)."""
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.data.device)


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``h += g * g; w -= lr * (g / sqrt(h + eps) + wd * w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def apply(self, w, g, slots, lr, wd):
        (h,) = slots
        g = self._prep_grad(g, w.dtype)
        h.add_(g * g)
        w.sub_(lr * (g / torch.sqrt(h + self.float_stable_eps) + wd * w))

    def fused_extra(self):
        return np.array([self.float_stable_eps], np.float32)

    def fused_kernel(self):
        return self.apply


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Alex Graves' variant (slots n, g and
    delta, momentum ``gamma2``); ``clip_weights`` clamps the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def pack_state(self, arrays):
        # the state is a tuple even with one slot (uncentered)
        return tuple(arrays)

    def create_state(self, index, weight):
        return tuple(_zeros(weight) for _ in range(3 if self.centered
                                                   else 1))

    def apply(self, w, g, slots, lr, wd):
        rho = self.gamma1
        g = self._prep_grad(g, w.dtype) + wd * w
        if self.centered:
            n, gbar, delta = slots
            n.mul_(rho).add_((1 - rho) * torch.square(g))
            gbar.mul_(rho).add_((1 - rho) * g)
            delta.mul_(self.gamma2).sub_(lr * g / torch.sqrt(
                n - torch.square(gbar) + self.epsilon))
            w.add_(delta)
        else:
            (n,) = slots
            n.mul_(rho).add_((1 - rho) * torch.square(g))
            w.sub_(lr * g / torch.sqrt(n + self.epsilon))
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)

    def fused_extra(self):
        cw = self.clip_weights if self.clip_weights else -1.0
        return np.array([self.gamma1, self.gamma2, self.epsilon, cw],
                        np.float32)

    def fused_kernel(self):
        return self.apply


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate; eager only)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def apply(self, w, g, slots, lr, wd):
        rho, eps = self.rho, self.epsilon
        acc_g, acc_delta = slots
        g = self._prep_grad(g, w.dtype)
        acc_g.mul_(rho).add_((1 - rho) * g * g)
        delta = (torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps)) * g
        acc_delta.mul_(rho).add_((1 - rho) * delta * delta)
        w.add_(-delta - wd * w)


@register
class Ftrl(Optimizer):
    """Follow the regularised leader (FTRL-proximal; eager only)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def apply(self, w, g, slots, lr, wd):
        dn, n = slots
        g = self._prep_grad(g, w.dtype)
        dn.add_(g - (torch.sqrt(n + g * g) - torch.sqrt(n)) * w / lr)
        n.add_(g * g)
        w.copy_((torch.sign(dn) * self.lamda1 - dn)
                / ((self.beta + torch.sqrt(n)) / lr + wd)
                * (torch.abs(dn) > self.lamda1))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    N(0, lr) noise, drawn from torch's default generator of the weight's
    device (seed it with ``torch.manual_seed``; eager only)."""

    def apply(self, w, g, slots, lr, wd):
        g = self._prep_grad(g, w.dtype)
        noise = torch.randn(w.shape, dtype=torch.float32,
                            device=w.device) * math.sqrt(lr)
        w.add_(-lr / 2 * (g + wd * w) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; the state is (momentum or
    None, the weight before the last update) (eager only)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.data.clone()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    def apply(self, w, g, slots, lr, wd):
        mom, prev = slots
        g = self._prep_grad(g, w.dtype)
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
        if mom is not None:
            mom.mul_(self.momentum).add_(delta)
            delta = mom
        prev.copy_(w)
        w.add_(delta)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += rescale_grad * g`` and the
    state a copy of the new weight (no update count)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight.data.add_(grad.data * self.rescale_grad)
            state.copy_(weight.data)


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
        tuples of numpy arrays (bf16 as f32; DCASGD's absent momentum
        None), keyed by parameter name where the optimizer knows it, else
        by index."""
        names = self.optimizer.idx2name
        host = {}
        for idx, state in self.states.items():
            host[names.get(idx, idx)] = tuple(
                _to_numpy(t) for t in _state_tensors(state))
        return pickle.dumps(host)

    def set_states(self, payload):
        """Load a ``.states`` payload (name- or index-keyed tuples of
        numpy arrays, see :func:`load_states`), copying into existing
        states in place: a state may be a view of the train step's slot
        slab."""
        loaded = load_states(payload)
        name2idx = {n: i for i, n in self.optimizer.idx2name.items()}
        for key, state in loaded.items():
            idx = name2idx.get(key, key) if isinstance(key, str) else key
            if isinstance(idx, str):
                logging.warning(
                    "optimizer state key %r has no index mapping; its "
                    "saved state will not be applied", key)
                continue
            arrays = [None if a is None else np.asarray(a)
                      for a in _state_tensors(state)]
            current = self.states.get(idx)
            if current is None:
                self.states[idx] = self.optimizer.pack_state(
                    [None if a is None else torch.from_numpy(a.copy())
                     for a in arrays])
                continue
            for dst, src in zip(_state_tensors(current), arrays):
                if dst is not None and src is not None:
                    with torch.no_grad():
                        dst.copy_(torch.from_numpy(src))


def _state_tensors(state):
    """A state's arrays as a tuple (None -> (), one array -> 1-tuple)."""
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


class _StatesUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays in builtin containers and refuses every
    other class, so that loading a payload never imports a package."""

    _BUILTINS = frozenset(("set", "frozenset", "complex", "bytearray",
                           "slice"))

    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "_codecs") or (
                module == "builtins" and name in self._BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "a .states payload holds numpy arrays only, not %s.%s: "
            "convert another package's arrays to numpy before saving"
            % (module, name))


def load_states(payload):
    """A ``.states`` payload: a pickled dict of tuples of numpy arrays
    (or None), keyed by parameter name or index.  Any other class in the
    pickle raises ``pickle.UnpicklingError``."""
    return _StatesUnpickler(io.BytesIO(payload)).load()


def _to_numpy(t):
    if t is None or isinstance(t, np.ndarray):
        return t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def get_updater(optimizer):
    return Updater(optimizer)
