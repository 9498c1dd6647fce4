"""PythonModule — modules whose computation is user-defined Python
(the port's ``mxnet_tpu/module/python_module.py``).

A BaseModule subclass for computation written directly in Python (no
Symbol graph), typically parameter-free glue in a SequentialModule
chain — e.g. a custom loss attached after a feature extractor.
``PythonLossModule`` takes a ``loss_function`` of torch tensors and
derives its gradient with torch's autograd (the JAX package's takes a
jax-traceable one and ``jax.grad``); an explicit ``grad_func`` still
overrides.
"""
from __future__ import annotations

import logging

import numpy as np

import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Base for python-computation modules (reference: python_module.py:11).

    Subclasses implement ``forward`` / ``backward`` / ``get_outputs`` /
    ``get_input_grads``; parameters are assumed empty (the common case —
    python modules act as glue/loss heads)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- properties ---------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters: none ---------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update_metric(self, eval_metric, labels):
        if not self._label_names:
            return
        outs = self.get_outputs()
        if outs and labels and tuple(outs[0].shape[:1]) != \
                tuple(labels[0].shape[:1]):
            # scalar-loss heads have no per-sample predictions to score
            return
        eval_metric.update(labels, outs)

    # -- binding -------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert grad_req == "write", \
            "PythonModule only supports grad_req='write'"
        self._data_shapes = [d if isinstance(d, DataDesc)
                             else DataDesc(d[0], d[1]) for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc)
                              else DataDesc(d[0], d[1])
                              for d in (label_shapes or [])]
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()


class PythonLossModule(PythonModule):
    """A loss head in Python (reference: python_module.py:219).

    ``loss_function(pred, label) -> scalar`` (torch tensors in, a scalar
    tensor out) gives both the forward loss value and, through autograd,
    the input gradient; or pass
    ``grad_func(pred, label) -> d loss/d pred`` explicitly (the reference's
    style).  Default (neither given): identity forward whose backward is
    the incoming head gradient — a passthrough tap.
    """

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None, loss_function=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._grad_func = grad_func
        self._loss_function = loss_function
        self._pred = None
        self._label = None
        self._pred_grad = None
        self._cached_pair = None      # (loss, grad) for the current batch

    def _compute_output_shapes(self):
        if self._loss_function is not None:
            return [DataDesc(self._output_names[0], (1,))]
        return [DataDesc(self._output_names[0],
                         tuple(self._data_shapes[0].shape))]

    def forward(self, data_batch, is_train=None):
        assert self.binded
        self._pred = data_batch.data[0]
        self._label = data_batch.label[0] if data_batch.label else None
        self._pred_grad = None
        self._cached_pair = None

    def _loss_and_grad(self):
        """(loss, d loss/d pred) for the current batch, from one forward
        and one ``torch.autograd.grad``, cached per batch."""
        if self._cached_pair is None:
            pred = self._pred.data.detach().requires_grad_(True)
            label = self._label.data if self._label is not None else None
            with torch.enable_grad():
                loss = self._loss_function(pred, label)
                grad, = torch.autograd.grad(loss, pred)
            self._cached_pair = (loss.detach(), grad)
        return self._cached_pair

    def get_outputs(self, merge_multi_context=True):
        if self._loss_function is not None:
            val, _ = self._loss_and_grad()
            return [nd.NDArray(val.reshape(1))]
        return [self._pred]

    def backward(self, out_grads=None):
        assert self.binded and self.for_training
        if self._grad_func is not None:
            g = self._grad_func(self._pred, self._label)
            self._pred_grad = g if isinstance(g, nd.NDArray) \
                else nd.array(np.asarray(g), ctx=self._pred.context)
        elif self._loss_function is not None:
            _, g = self._loss_and_grad()
            self._pred_grad = nd.NDArray(g)
        else:
            if out_grads is None:
                raise MXNetError(
                    "PythonLossModule passthrough needs out_grads (no "
                    "loss_function/grad_func given)")
            self._pred_grad = out_grads[0] if isinstance(out_grads, list) \
                else out_grads

    def get_input_grads(self, merge_multi_context=True):
        assert self._pred_grad is not None, "call backward() first"
        return [self._pred_grad]

    def install_monitor(self, mon):
        pass
