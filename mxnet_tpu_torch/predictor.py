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
a CUDA graph on the card, replayed for every later call).

Deployment export (the JAX package's StableHLO export) goes through
``torch.export``: :meth:`Predictor.export` writes the forward at the
bound input shapes, weights included, as a saved ``ExportedProgram``
(``torch.export.save``); :func:`load_exported` loads it into a callable
that runs without the symbol, the executor or this class.  The graph
holds the hand-written kernels as the operators
``mxnet_tpu_torch::fused_fwd`` and ``::flash_fwd``, which launch kernels
A and C on the card and run their plain versions on the host, so a
program exported on either device runs on either.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .executor import simple_bind

__all__ = ["Predictor", "DecodePredictor", "DecodeServer", "NGramProposer",
           "DraftProposer", "load_exported"]


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
    plain : bool
        Run every op that owns a kernel through its plain PyTorch
        version, whatever the device (the reference the kernels are held
        to; an exported program then holds no kernel operator).
    """

    def __init__(self, symbol, params, input_shapes, ctx=None,
                 output_names=None, type_dict=None, plain=False):
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
        self._plain = bool(plain)
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
                          type_dict=self._type_dict, plain=self._plain,
                          shared_exec=shared_exec, **shapes)
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

    # ------------------------------------------------------------------
    # deployment export
    # ------------------------------------------------------------------
    def _feed_names(self):
        """The data inputs an exported program takes, in the symbol's
        order: the free inputs named in ``input_shapes``."""
        return [n for n in self._data_names if n in self._input_shapes]

    def _export_module(self):
        """The inference forward as an ``nn.Module`` of the data inputs
        (:meth:`_feed_names`): its buffers are the executor's other
        arguments (the weights, and unfed inputs such as labels, which
        stay zeros) and aux states; its forward is the graph walk
        (``run_graph``) on the executor's inference op context, under
        ``no_grad`` — the counterpart of the reference's ``_pure_fn``."""
        from .analysis.artifact import BufferModule
        from .executor import run_graph

        exe = self._exec
        feed = self._feed_names()
        aux_names = set(exe._aux_names)
        env = {n: exe.arg_dict[n].data for n in exe._arg_names
               if n not in feed}
        env.update({n: exe.aux_dict[n].data for n in exe._aux_names})
        symbol, octx = self._symbol, exe.op_context(False)

        def forward(*data, env):
            args = {n: t for n, t in env.items() if n not in aux_names}
            args.update(zip(feed, data))
            aux = {n: t for n, t in env.items() if n in aux_names}
            with torch.no_grad():
                outs, _ = run_graph(symbol, args, aux, octx)
            return tuple(outs)

        return BufferModule(forward, env)

    def artifact(self, name="predict_forward"):
        """:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` of the
        inference forward at the bound input shapes: the exported graph
        (``torch.export``) and its text, with the kernels' operators as
        nodes (:func:`~mxnet_tpu_torch.analysis.kernel_ops` counts
        them)."""
        from .analysis.artifact import artifact_from_export

        exe = self._exec
        feed = self._feed_names()
        return artifact_from_export(
            self._export_module(),
            tuple(exe.arg_dict[n].data for n in feed), name,
            donated_leaves=0, input_names=feed,
            output_names=self.output_names, device=str(self._device),
            plain=self._plain)

    def export(self, path=None):
        """Serialize the inference forward, weights included, as a saved
        ``torch.export`` program; returns its bytes and writes them to
        ``path`` when one is given.  :func:`load_exported` runs it."""
        buf = io.BytesIO()
        torch.export.save(self.artifact().program, buf)
        blob = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
        return blob

    def export_stablehlo_text(self):
        """The exported program's text (``str(ExportedProgram)``).  Named
        as the JAX package's method for parity: it is torch's exported
        graph, not StableHLO."""
        return self.artifact().exported_text


def _program_device(ep):
    """The one device an exported program's state and inputs are on
    (None for a program with no tensor)."""
    devices = {t.device for t in list(ep.state_dict.values())
               + list(ep.constants.values()) if isinstance(t, torch.Tensor)}
    for node in ep.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            devices.add(val.device)
    if len(devices) > 1:
        raise MXNetError("exported program spans devices %s"
                         % sorted(map(str, devices)))
    return next(iter(devices), None)


def load_exported(blob_or_path, device=None):
    """Load a :meth:`Predictor.export` program (a path, or its bytes) into
    a callable that takes the data inputs (tensors, NDArrays or numpy, in
    the order of the symbol's inputs) and returns a tuple of output
    tensors.

    ``device`` is where it runs: the card by default, as for every entry
    point of the port (it raises without one); ``cpu()`` runs it on the
    host.  A program exported on another device is moved there with
    ``torch.export.passes.move_to_device_pass``.  The graph calls the
    kernels' operators, which importing :mod:`mxnet_tpu_torch` registers:
    that, and torch, is all it needs (the counterpart of the
    reference's "needs only an XLA runtime").  The callable's
    ``input_shapes`` lists the program's data inputs' shapes in feed
    order (what the C ABI checks declared shapes against)."""
    dev = resolve_device(device)
    if isinstance(blob_or_path, (str, os.PathLike)):
        ep = torch.export.load(blob_or_path)
    else:
        ep = torch.export.load(io.BytesIO(bytes(blob_or_path)))
    src = _program_device(ep)
    if src is not None and src != dev:
        try:
            from torch.export.passes import move_to_device_pass
        except ImportError as exc:
            raise MXNetError(
                "this torch (%s) cannot move an exported program from %s "
                "to %s: export it on the device that will run it"
                % (torch.__version__, src, dev)) from exc
        ep = move_to_device_pass(ep, str(dev))
    names = set(ep.graph_signature.user_inputs)
    vals = [node.meta["val"] for node in ep.graph.nodes
            if node.op == "placeholder" and node.name in names]
    dtypes = [v.dtype for v in vals]
    module = ep.module()

    def run(*data_vals):
        if len(data_vals) != len(dtypes):
            raise MXNetError("the exported program takes %d inputs, got %d"
                             % (len(dtypes), len(data_vals)))
        args = []
        for value, dtype in zip(data_vals, dtypes):
            if isinstance(value, nd.NDArray):
                value = value.data
            elif not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            args.append(value.to(device=dev, dtype=dtype))
        with torch.no_grad():
            return tuple(module(*args))

    run.input_shapes = [tuple(int(d) for d in v.shape) for v in vals]
    return run


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
