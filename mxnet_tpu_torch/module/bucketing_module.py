"""BucketingModule — variable-length (bucketed) training, the port of
``mxnet_tpu/module/bucketing_module.py``.

``sym_gen(bucket_key)`` gives each bucket its own graph (an unrolled
RNN of that many steps).  A ``_primary`` module (the default bucket)
owns the parameters, the optimizer and the compiled train step;
``switch_bucket`` binds each further bucket on first use against the
primary (``bind(shared_module=)``: the same parameter NDArrays wherever
name and shape match) and lends it the primary's optimizer, updater and
train step (``borrow_optimizer``).  Every bucket therefore trains
through the one store and slab plan — its own captured program, all of
them in one memory pool: its graph reads the shared slab views, its
gradients land in the one grad slab, and one multi-tensor update runs a
step, whichever bucket ran.  ``fit``'s metric is bound once for every
bucket, bound now or later (``_bind_metric``), and ``_dispatch_fence``
is the active bucket's.

``predict`` / ``iter_predict`` / ``score`` run each batch through its
bucket's module (``forward`` switches bucket), so every bucket replays
its own captured inference forward; ``install_monitor`` puts the
monitor on every bucket bound so far (each then trains eagerly).

The reference's one exception is ported as it stands
(``_ensure_fused_compat``): a bucket whose parameters are not all shared
with the primary (a parameter whose shape varies with the bucket gets
storage of its own) cannot ride the shared step, and then every bucket
takes the per-parameter update, with a log line.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, compute_dtype=None,
                 plain=False):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._module_kwargs = dict(
            logger=logger, context=context,
            fixed_param_names=fixed_param_names, compute_dtype=compute_dtype,
            plain=plain)
        self._clear()

    def _clear(self):
        self._buckets = {}
        self._active = None
        self._fit_metric = None

    @property
    def _primary(self):
        return self._buckets.get(self._default_bucket_key)

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, **self._module_kwargs)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        if self._active is not None:
            return self._active.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self._active is not None:
            return self._active.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._active.data_shapes

    @property
    def label_shapes(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._active.label_shapes

    @property
    def output_shapes(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._active.output_shapes

    @property
    def symbol(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._active.symbol

    # ------------------------------------------------------------------
    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        return self._active.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        self._active.init_params(initializer=initializer,
                                 arg_params=arg_params, aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init)
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        snapshot = self.get_params() if self.params_initialized else None
        if force_rebind:
            self._clear()
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        primary = self._new_module(self._default_bucket_key)
        primary.bind(data_shapes, label_shapes, for_training,
                     inputs_need_grad, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: primary}
        self._active = primary
        if snapshot is not None:
            self.set_params(*snapshot)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the active bucket, binding its module
        against the primary's arrays on first use."""
        if not self.binded:
            raise MXNetError("call bind before switching bucket")
        module = self._buckets.get(bucket_key)
        if module is None:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._primary.for_training,
                        shared_module=self._primary)
            if self.optimizer_initialized:
                module.borrow_optimizer(self._primary)
                self._ensure_fused_compat(module)
            if self._fit_metric is not None:
                module._bind_metric(self._fit_metric)
            self._buckets[bucket_key] = module
        self._active = module

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        primary = self._primary
        primary.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        # every bucket adopts the primary's train step: one slab plan
        for module in self._buckets.values():
            if module is not primary:
                module.borrow_optimizer(primary)
                self._ensure_fused_compat(module)
        self.optimizer_initialized = True

    def _ensure_fused_compat(self, module):
        """A bucket whose parameters are only partly shared with the
        primary (a shape-varying parameter has storage of its own)
        cannot ride the shared train step: every bucket then takes the
        per-parameter update, so all of them see one source of truth.
        The slab views stay the parameters' storage, so nothing is handed
        back."""
        step = self._primary._train_step
        if step is None or step.compatible(module._exec_group):
            return
        self.logger.info(
            "bucket parameters are not fully shared with the primary; "
            "using the eager update path for all buckets")
        step.detach_metric()
        for m in list(self._buckets.values()) + [module]:
            m._train_step = None
            m._pending_metric = None

    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """The active bucket's own ``forward_backward``, so that every
        bucket reaches the shared train step."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward_backward(data_batch)

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._active.backward(out_grads=out_grads)

    def update(self):
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            raise MXNetError("bind, initialize and init_optimizer first")
        self._active.update()

    def get_outputs(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized
                and self.inputs_need_grad):
            raise MXNetError("bind with inputs_need_grad first")
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._active.update_metric(eval_metric, labels)

    def _bind_metric(self, eval_metric):
        # one store for every bucket: binding through each module arms
        # it for all, and buckets bound later in the fit take it too
        self._fit_metric = eval_metric
        for module in self._buckets.values():
            module._bind_metric(eval_metric)

    def _dispatch_fence(self):
        if self._active is None:
            return None
        return self._active._dispatch_fence()

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("call bind first")
        for module in self._buckets.values():
            module.install_monitor(mon)
