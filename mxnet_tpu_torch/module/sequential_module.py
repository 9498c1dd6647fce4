"""SequentialModule — a pipeline of modules executed back-to-back (the
port's ``mxnet_tpu/module/sequential_module.py``).

``add`` with ``take_labels`` / ``auto_wiring`` metadata and the
BaseModule surface, around an explicit ``_Stage`` record per child and
one shape-chaining helper.  Each stage is a module of its own: a port
``Module`` stage keeps its executor, its optimizer and its slab plan,
and a stage after the first binds with ``inputs_need_grad`` (its input
gradient is the previous stage's head gradient).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule


class _Stage:
    """One link of the chain: a module plus its wiring flags."""

    __slots__ = ("module", "takes_labels", "auto_wire")

    def __init__(self, module, takes_labels=False, auto_wire=False):
        self.module = module
        self.takes_labels = takes_labels
        self.auto_wire = auto_wire


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None
        self._data_shapes = None

    def add(self, module, **kwargs):
        unknown = set(kwargs) - {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        assert not unknown, "Unknown meta %s" % sorted(unknown)
        self._stages.append(_Stage(
            module,
            takes_labels=bool(kwargs.get(self.META_TAKE_LABELS)),
            auto_wire=bool(kwargs.get(self.META_AUTO_WIRING))))
        # adding a layer invalidates any previous setup
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def _modules(self):
        return [s.module for s in self._stages]

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for stage in self._stages:
            a, x = stage.module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for stage in self._stages:
            stage.module.init_params(
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_init=force_init)
        self._assert_unique_params()
        self.params_initialized = True

    def _assert_unique_params(self):
        owners = {}
        for i, stage in enumerate(self._stages):
            for group in stage.module.get_params():
                for name in group:
                    if name in owners:
                        raise AssertionError(
                            "Duplicated parameter name %s: layer %d (%s) and "
                            "layer %d (%s)" % (
                                name, i, type(stage.module),
                                owners[name], type(self._modules[owners[name]])))
                    owners[name] = i

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._stages, "Attempting to bind an empty SequentialModule"

        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes if any(
            s.takes_labels for s in self._stages) else None

        shapes = list(data_shapes)
        for i, stage in enumerate(self._stages):
            if stage.auto_wire:
                # adopt the child's own input names for the incoming shapes
                names = stage.module.data_names
                assert len(names) == len(shapes)
                shapes = [(n, s[1]) for n, s in zip(names, shapes)]
            stage.module.bind(
                data_shapes=shapes,
                label_shapes=label_shapes if stage.takes_labels else None,
                for_training=for_training,
                inputs_need_grad=bool(for_training and
                                      (inputs_need_grad or i > 0)),
                force_rebind=force_rebind, grad_req=grad_req)
            shapes = self._outgoing_shapes(stage.module, shapes)

    @staticmethod
    def _outgoing_shapes(module, incoming):
        """Output (name, shape) pairs of a bound child, which become the
        next child's data shapes."""
        if getattr(module, "symbol", None) is None:
            # symbol-less children (PythonModule) declare their own
            return [(d.name, tuple(d.shape)) for d in module.output_shapes]
        _, out_shapes, _ = module.symbol.infer_shape(
            **{name: shape for name, shape in incoming})
        return [(name, tuple(shape))
                for name, shape in zip(module.output_names, out_shapes)]

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for stage in self._stages:
            stage.module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                        optimizer_params=optimizer_params,
                                        force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = data_batch
        for stage, nxt in zip(self._stages, self._stages[1:] + [None]):
            stage.module.forward(batch, is_train=is_train)
            if nxt is None:
                break
            batch = DataBatch(
                data=stage.module.get_outputs(),
                label=data_batch.label if nxt.takes_labels else None,
                pad=data_batch.pad, index=data_batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._stages) - 1, -1, -1):
            self._stages[i].module.backward(out_grads=out_grads)
            if i:
                out_grads = self._stages[i].module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        for stage in self._stages:
            stage.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage in self._stages:
            if stage.takes_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages:
            stage.module.install_monitor(mon)
