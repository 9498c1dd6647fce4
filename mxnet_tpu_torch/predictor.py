"""Standalone inference: symbol JSON + parameters -> a captured forward
(the port of ``mxnet_tpu/predictor.py``, the counterpart of the
reference's C predict API):

==============================  =======================================
reference                       here
==============================  =======================================
``MXPredCreate``                ``Predictor(symbol, params, shapes)``
``MXPredCreatePartialOut``      ``Predictor(..., output_names=[...])``
``MXPredReshape``               ``Predictor.reshape({...})``
``MXPredSetInput/Forward``      ``Predictor.forward(**inputs)``
``MXPredGetOutputShape``        ``Predictor.output_shapes``
``MXPredGetOutput``             ``Predictor.get_output(i)``
==============================  =======================================

Each bound input shape has one executor whose inference forward is one
captured program (:class:`~mxnet_tpu_torch.train_step.CompiledForward`:
a CUDA graph on the card, replayed for every later call).  The JAX
package's StableHLO export (``export``, ``artifact``,
``export_stablehlo_text``, ``load_exported``) has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .executor import simple_bind

__all__ = ["Predictor", "DecodePredictor", "DecodeServer", "NGramProposer",
           "DraftProposer"]


def _shape_key(input_shapes):
    """The bind cache's key for a set of input shapes."""
    return tuple(sorted((n, tuple(s)) for n, s in input_shapes.items()))


class Predictor:
    """Inference-only executor from a trained model.

    Parameters
    ----------
    symbol : Symbol or str
        The network: a Symbol, a JSON string, or a ``*-symbol.json`` path.
    params : dict, str, or bytes
        ``{name: NDArray, tensor or numpy}`` (``arg:`` / ``aux:``
        prefixes optional), a ``.params`` file path, or the file's bytes.
    input_shapes : dict
        ``{input_name: shape}`` for every data input.
    ctx : Context, optional
        The device.  Unlike the JAX package's Predictor, which defaults
        to the CPU, the default is the card, as for every entry point of
        the port (it raises without one); pass ``cpu()`` for the host.
    output_names : list of str, optional
        Predict a subset of the outputs or internal nodes
        (``MXPredCreatePartialOut``); names with or without the
        ``_output`` suffix.
    type_dict : dict, optional
        Input dtypes (default float32).
    """

    def __init__(self, symbol, params, input_shapes, ctx=None,
                 output_names=None, type_dict=None):
        if isinstance(symbol, str):
            symbol = sym_mod.load_json(symbol) \
                if symbol.lstrip().startswith("{") else sym_mod.load(symbol)
        if output_names:
            internals = symbol.get_internals()
            available = internals.list_outputs()
            picked = []
            for name in output_names:
                hit = next((c for c in (name, name + "_output")
                            if c in available), None)
                if hit is None:
                    raise MXNetError("output %r not found among internal "
                                     "nodes" % name)
                picked.append(internals[hit])
            symbol = sym_mod.Group(picked)

        arg_params, aux_params = _as_param_dicts(params)
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else gpu(0)
        self._device = resolve_device(self._ctx)
        self._input_shapes = dict(input_shapes)
        self._type_dict = dict(type_dict) if type_dict else None
        # free inputs: arguments without stored weights; those given no
        # shape (loss labels) are inferred and stay zeros
        self._data_names = [n for n in symbol.list_arguments()
                            if n not in arg_params and n not in aux_params]
        extra = [n for n in self._input_shapes if n not in self._data_names]
        if extra:
            raise MXNetError("input_shapes names %s are not free inputs of "
                             "the symbol" % extra)
        self._arg_params = arg_params
        self._aux_params = aux_params
        self._exec = self._bind(self._input_shapes)
        self._outputs = None
        # executors by input shapes, shared with reshape() clones:
        # reshaping back reuses that shape's executor and its captured
        # forward
        self._bind_cache = {_shape_key(self._input_shapes): self._exec}

    def _bind(self, shapes, shared_exec=None):
        """An inference executor at ``shapes`` holding the parameters; with
        ``shared_exec``, the arrays of the same name and shape are its
        (the weights are not held twice)."""
        exe = simple_bind(self._symbol, self._device, grad_req="null",
                          type_dict=self._type_dict, shared_exec=shared_exec,
                          **shapes)
        exe.copy_params_from(self._arg_params, self._aux_params,
                             allow_extra_params=True)
        return exe

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, **kwargs):
        """Build from ``prefix-symbol.json`` and ``prefix-%04d.params``."""
        from .model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        params = {"arg:%s" % k: v for k, v in arg_params.items()}
        params.update({"aux:%s" % k: v for k, v in aux_params.items()})
        return cls(symbol, params, input_shapes, **kwargs)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def output_shapes(self):
        _, out_shapes, _ = self._symbol.infer_shape(**self._input_shapes)
        return list(zip(self.output_names, out_shapes))

    def forward(self, **inputs):
        """Run inference on the given inputs (NDArrays, tensors or numpy,
        at the bound shapes); returns the list of output NDArrays."""
        feeds = {}
        for name, value in inputs.items():
            if name not in self._data_names:
                raise MXNetError("unknown input %r (inputs are %s)"
                                 % (name, self._data_names))
            if not isinstance(value, (nd.NDArray, torch.Tensor)):
                value = np.asarray(value)
            bound = self._input_shapes.get(
                name, self._exec.arg_dict[name].shape)
            if tuple(value.shape) != tuple(bound):
                raise MXNetError(
                    "input %r shape %s does not match bound shape %s - use "
                    "reshape()" % (name, tuple(value.shape), bound))
            feeds[name] = value
        self._outputs = self._exec.forward(is_train=False, **feeds)
        return list(self._outputs)

    def get_output(self, index=0):
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        return self._outputs[index]

    def reshape(self, input_shapes):
        """A Predictor bound to other input shapes, sharing the weights
        and the bind cache (``MXPredReshape``): a shape bound before
        reuses its executor and captured forward."""
        shapes = dict(self._input_shapes)
        shapes.update(input_shapes)
        clone = Predictor.__new__(Predictor)
        clone.__dict__.update(self.__dict__)
        clone._input_shapes = shapes
        key = _shape_key(shapes)
        exe = self._bind_cache.get(key)
        if exe is None:
            exe = self._bind(shapes, shared_exec=self._exec)
            self._bind_cache[key] = exe
        clone._exec = exe
        clone._outputs = None
        return clone


def _as_param_dicts(params):
    """``(arg_params, aux_params)`` of NDArrays from a dict (``arg:`` /
    ``aux:`` prefixes optional; NDArrays, tensors or numpy), a ``.params``
    path, or the file's bytes."""
    if isinstance(params, (str, bytes, bytearray, memoryview)):
        params = nd._load(params, cpu())
    if not isinstance(params, dict):
        raise MXNetError("params must be a dict, a .params path, or bytes")
    arg_params, aux_params = {}, {}
    for key, value in params.items():
        if isinstance(value, torch.Tensor):
            value = nd.NDArray(value)
        elif not isinstance(value, nd.NDArray):
            value = nd.array(np.asarray(value), ctx=cpu())
        if key.startswith("arg:"):
            arg_params[key[4:]] = value
        elif key.startswith("aux:"):
            aux_params[key[4:]] = value
        else:
            arg_params[key] = value
    return arg_params, aux_params


# incremental decoding, re-exported so the deployment surface is one
# import, as in the JAX package
from .decode import (DecodePredictor, DecodeServer,  # noqa: E402
                     DraftProposer, NGramProposer)
