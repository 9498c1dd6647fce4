"""Weight initializers (the counterparts of ``mxnet_tpu/initializer.py``'s
``InitDesc``, ``Initializer``, ``Uniform``, ``Normal``, ``Orthogonal``,
``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``Zero``, ``One``, ``Constant``,
``Load``, ``Mixed``, ``LSTMBias`` and ``FusedRNN``).

A parameter's role comes from its name suffix, as in the JAX package:
``*_weight`` takes the scheme's random values, ``*_bias``/``*_beta``
zeros, ``*_gamma`` ones, BatchNorm statistics their constants; a name
starting with ``upsampling`` takes the bilinear kernel.  Random values
are drawn on the host from PyTorch's default ``torch.Generator`` (seed it
with ``torch.manual_seed``), so they differ from the JAX package's numpy
draws; parity tests load the same numpy values into both instead.  The
deterministic schemes (the constants, Bilinear, Load, Mixed's routing)
give the JAX package's values exactly.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Orthogonal",
           "Xavier", "MSRAPrelu", "Bilinear", "Constant", "One", "Zero",
           "Load", "Mixed", "LSTMBias", "FusedRNN", "create",
           "init_registry"]

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


def _bilinear_kernel(shape):
    """The bilinear upsampling kernel of a (..., H, W) shape, f32."""
    h, w = shape[-2], shape[-1]
    f = np.ceil(w / 2.0)
    center = (2 * f - 1 - f % 2) / (2.0 * f)
    ys, xs = np.ogrid[:h, :w]
    tap = (1 - np.abs(xs / f - center)) * (1 - np.abs(ys / f - center))
    return np.broadcast_to(tap, shape).astype(np.float32)


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
        if name_s.startswith("upsampling"):
            arr[:] = _bilinear_kernel(arr.shape)
            return
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


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix over (rows, prod(other dims)) (Saxe et
    al. 2013): QR of a uniform or normal draw, the signs of R's diagonal
    folded into Q."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def generate(self, name, shape):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        size = (max(rows, cols), min(rows, cols))
        if self.rand_type == "uniform":
            seed = torch.rand(size, dtype=torch.float64) * 2.0 - 1.0
        elif self.rand_type == "normal":
            seed = torch.randn(size, dtype=torch.float64)
        else:
            raise ValueError("rand_type must be 'uniform' or 'normal'")
        q, r = torch.linalg.qr(seed)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.scale * q).reshape(tuple(shape))


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
class MSRAPrelu(Xavier):
    """He / Kaiming initialisation for a PReLU slope: Xavier gaussian at
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a Deconvolution's weight)."""

    def generate(self, name, shape):
        return torch.from_numpy(_bilinear_kernel(shape))


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


@register
class Load:
    """Values from a ``{name: array}`` dict (``arg:`` / ``aux:`` prefixes
    dropped); names it lacks go to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {}
        for key, value in param.items():
            bare = key.split(":", 1)[1] if key[:4] in ("arg:", "aux:") \
                else key
            self.param[bare] = value
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        source = self.param.get(str(name))
        if source is not None:
            if tuple(source.shape) != tuple(arr.shape):
                raise MXNetError(
                    "Loaded parameter %r has shape %s, expected %s"
                    % (str(name), tuple(source.shape), tuple(arr.shape)))
            arr[:] = source
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError("Parameter %r is not in the loaded dict and no "
                             "default_init was given" % str(name))


@register
class Mixed:
    """Routes a parameter to the first initializer whose regular
    expression matches its name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for matcher, init in self.map:
            if matcher.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("Parameter %r matched no pattern (have: %s)"
                         % (str(name), [m.pattern for m, _ in self.map]))


def _lstm_bias(shape, forget_bias):
    """Zero bias with the forget gate (the second quarter, gate order
    i, f, c, o) set to ``forget_bias``."""
    bias = np.zeros(shape, np.float32)
    nh = shape[0] // 4
    bias[nh:2 * nh] = forget_bias
    return bias


@register
class LSTMBias(Initializer):
    """An LSTM bias with a configurable forget-gate bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def generate(self, name, shape):
        return torch.from_numpy(_lstm_bias(shape, self.forget_bias))

    # attr dispatch enters through _init_weight whatever the target is
    _init_bias = Initializer._init_weight


@register
class FusedRNN(Initializer):
    """Initialize a FusedRNNCell's packed parameter blob: unpack it, run
    the inner initializer (or the global one) over each weight, set each
    LSTM bias as ``LSTMBias`` does, and pack it again."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = init_registry[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._spec = dict(num_hidden=num_hidden, num_layers=num_layers,
                          mode=mode, bidirectional=bidirectional,
                          forget_bias=forget_bias)

    def _init_weight(self, name, arr):
        from .rnn.rnn_cell import FusedRNNCell

        inner = self._init or getattr(name, "global_init", None)
        if inner is None:
            raise MXNetError("FusedRNN needs an inner initializer (or a "
                             "global one via InitDesc) for its weights")
        spec = self._spec
        # a bare prefix: this cell only translates the layout
        cell = FusedRNNCell(spec["num_hidden"], spec["num_layers"],
                            spec["mode"], spec["bidirectional"],
                            forget_bias=spec["forget_bias"], prefix="")
        pieces = cell.unpack_weights({"parameters": arr.asnumpy()})
        for pname, piece in pieces.items():
            if spec["mode"] == "lstm" and pname.endswith("bias"):
                piece[:] = _lstm_bias(piece.shape, spec["forget_bias"])
            else:
                # an NDArray over the piece's memory: written in place
                inner(pname, NDArray(torch.from_numpy(piece)))
        arr[:] = cell.pack_weights(pieces)["parameters"]

    # '<prefix>parameters' has no role suffix; direct calls route here too
    _init_default = _init_weight
