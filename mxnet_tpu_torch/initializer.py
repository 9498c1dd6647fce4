"""Weight initializers (the counterparts of ``mxnet_tpu/initializer.py``'s
``InitDesc``, ``Initializer``, ``Uniform``, ``Normal``, ``Xavier``,
``Zero``, ``One`` and ``Constant``).

A parameter's role comes from its name suffix, as in the JAX package:
``*_weight`` takes the scheme's random values, ``*_bias``/``*_beta``
zeros, ``*_gamma`` ones, BatchNorm statistics their constants.  Random
values are drawn on the host from PyTorch's default ``torch.Generator``
(seed it with ``torch.manual_seed``), so they differ from the JAX
package's numpy draws; parity tests load the same numpy values into both
instead.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Xavier",
           "Constant", "One", "Zero", "create", "init_registry"]

init_registry = {}


def register(klass):
    init_registry[klass.__name__.lower()] = klass
    return klass


def create(spec):
    """An initializer from its ``dumps()`` JSON form."""
    klass, kwargs = json.loads(spec)
    return init_registry[klass.lower()](**kwargs)


class InitDesc(str):
    """A parameter name plus its Variable attributes (a per-Variable
    ``__init__`` attr overrides the global initializer)."""

    def __new__(cls, name, attrs=None, global_init=None):
        desc = super().__new__(cls, name)
        desc.attrs = attrs or {}
        desc.global_init = global_init
        return desc


# suffix -> method name, checked in order (the JAX package's table)
_ROLE_RULES = (
    ("moving_inv_var", "_init_zero"),
    ("moving_mean", "_init_zero"),
    ("moving_var", "_init_one"),
    ("moving_avg", "_init_zero"),
    ("weight", "_init_weight"),
    ("gamma", "_init_gamma"),
    ("beta", "_init_beta"),
    ("bias", "_init_bias"),
)


class Initializer:
    """Base class: routes a parameter to its role's rule; subclasses
    override ``generate`` (the values of weight parameters)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr):
        spec = getattr(name, "attrs", {}).get("__init__")
        if spec:
            create(spec)._init_weight(name, arr)
            return
        name_s = str(name)
        for suffix, method in _ROLE_RULES:
            if name_s.endswith(suffix):
                getattr(self, method)(name, arr)
                return
        self._init_default(name, arr)

    def _init_zero(self, _, arr):
        arr[:] = torch.zeros(arr.shape)

    def _init_one(self, _, arr):
        arr[:] = torch.ones(arr.shape)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        arr[:] = self.generate(name, arr.shape)

    def generate(self, name, shape):
        """A host tensor of weight values for ``shape``."""
        raise NotImplementedError(
            "%s must implement generate()" % type(self).__name__)

    def _init_default(self, name, arr):
        raise MXNetError(
            "No initialization rule matches parameter %r; recognized "
            "suffixes: %s (or attach an init attr to the Variable)"
            % (name, ", ".join(s for s, _ in _ROLE_RULES)))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def generate(self, name, shape):
        return (torch.rand(tuple(shape), dtype=torch.float64) * 2.0 - 1.0) \
            * self.scale


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def generate(self, name, shape):
        return torch.randn(tuple(shape), dtype=torch.float64) * self.sigma


def _fan_in_out(shape):
    """(fan_in, fan_out); dims beyond the first two multiply both."""
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


@register
class Xavier(Initializer):
    """Glorot-style variance scaling."""

    _FACTORS = {
        "avg": lambda fi, fo: (fi + fo) / 2.0,
        "in": lambda fi, fo: fi,
        "out": lambda fi, fo: fo,
    }

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if factor_type not in self._FACTORS:
            raise ValueError("factor_type must be one of %s"
                             % sorted(self._FACTORS))
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("rnd_type must be 'uniform' or 'gaussian'")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def generate(self, name, shape):
        fan_in, fan_out = _fan_in_out(shape)
        bound = np.sqrt(self.magnitude
                        / self._FACTORS[self.factor_type](fan_in, fan_out))
        if self.rnd_type == "uniform":
            return (torch.rand(tuple(shape), dtype=torch.float64) * 2.0
                    - 1.0) * bound
        return torch.randn(tuple(shape), dtype=torch.float64) * bound


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def generate(self, name, shape):
        return torch.full(tuple(shape), float(self.value))

    def _init_default(self, name, arr):
        arr[:] = self.generate(name, arr.shape)


@register
class One(Constant):
    def __init__(self):
        super().__init__(1.0)
        self._kwargs = {}


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)
        self._kwargs = {}
